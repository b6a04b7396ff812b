"""Experiment loggers of the port (the JAX package's ``loggers``)."""

from lmms_owc_tpu_torch.loggers._wandb import WandbLogger

__all__ = ["WandbLogger"]
