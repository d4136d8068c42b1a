from repro_torch.models.lm import LM  # noqa: F401
