"""Version info for deepspeed_tpu_torch."""

__version__ = "0.1.0"
