from repro_torch.core.engine.bundle import StepBundle

__all__ = ["StepBundle"]
