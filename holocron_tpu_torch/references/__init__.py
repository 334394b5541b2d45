"""The training CLIs of ``references/``, ported: ``python -m
holocron_tpu_torch.references.<task>.train``."""
