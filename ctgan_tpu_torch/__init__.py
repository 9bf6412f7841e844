"""ctgan_tpu_torch: the PyTorch/CUDA port of ``ctgan_tpu`` for NVIDIA Hopper.

It imports neither JAX nor ``ctgan_tpu``; the JAX package is the reference
its tests hold it against.  Modules mirror the JAX package's names.  The one
TPU kernel of the JAX package, the Pallas dropout-mask kernel, is the CUDA
kernel ``csrc/dropout_mask.cu`` here (``kernels.dropout``), whose second
entry draws the trainer's dequantisation noise from the same Philox bits.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
