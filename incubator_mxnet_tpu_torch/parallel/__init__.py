"""The training step as one program (counterpart of
``incubator_mxnet_tpu/parallel``, on one device): :class:`FusedTrainStep`.
Meshes, sharding, FSDP and the sequence-parallel cores wait for ROADMAP
A.10."""
from .trainer_step import FusedTrainStep

__all__ = ["FusedTrainStep"]
