""" The primary user interface: run, contexts, sample, functions, results, regression. """
from romcomma_tpu_torch.user import contexts, functions, regression, results, run, sample
