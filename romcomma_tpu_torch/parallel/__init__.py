"""The large-N variant route: ``distributed.DistributedGP`` on one device.

Counterpart of ``romcomma_tpu/parallel/``. Only the one-device
``DistributedGP`` is ported; the multi-device engines (the ring gram, the
block-cyclic and deferred factorizations, the covariant and GSA meshes) are
not, and ``DistributedGP`` refuses a mesh of more than one device by name.
"""
