"""The large-N variant route and its meshes of ranks.

Counterpart of ``romcomma_tpu/parallel/``: ``distributed.DistributedGP`` on
one device or over an ('n',) mesh of torch.distributed ranks with the
'cyclic' and 'cyclic2' (``cyclic_deferred``) engines; ``mesh`` for the
('l', 'n') training step and the ('k',) fold mesh; ``multihost`` for folds
shared out over processes; ``spawn`` to run one function on a fresh group of
ranks; ``covariant_mesh`` for the covariant MOGP's (L N, L N) chain on the
'cyclic2' engine.
"""
