"""Serving (counterpart of ``incubator_mxnet_tpu/serving``): FrozenModel
snapshots, the DynamicBatcher and the HTTP ModelServer."""
from .batcher import DynamicBatcher, Request
from .errors import (DeadlineExceededError, InvalidInputError,
                     QueueFullError, ReshardingGateError, ServerClosedError,
                     ServingError)
from .frozen import FrozenModel, default_buckets
from .server import ModelServer

__all__ = ["DynamicBatcher", "Request", "FrozenModel", "default_buckets",
           "ModelServer", "ServingError", "InvalidInputError",
           "QueueFullError", "DeadlineExceededError", "ServerClosedError",
           "ReshardingGateError"]
