""" The primary user interface: run, contexts, sample, functions, results. """
from romcomma_tpu_torch.user import contexts, functions, results, run, sample
