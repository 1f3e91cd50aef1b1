"""Training of the port (counterpart of ``repro.train``): optimizer, GMR
gradient compression, step builders."""

from .grad_compress import (CompressionConfig, compress, compressed_mean_grads,
                            compression_ratio, decompress, is_compressible)
from .optimizer import OptimizerConfig, adamw_update, global_norm, init_opt_state, lr_at
from .train_step import (cross_entropy, init_train_state, make_compressed_train_step,
                         make_loss_fn, make_train_step)

__all__ = [
    "CompressionConfig", "compress", "compressed_mean_grads", "compression_ratio", "decompress",
    "is_compressible",
    "OptimizerConfig", "adamw_update", "global_norm", "init_opt_state", "lr_at",
    "cross_entropy", "init_train_state", "make_compressed_train_step", "make_loss_fn",
    "make_train_step",
]
