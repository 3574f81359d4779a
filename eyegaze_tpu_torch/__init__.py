"""eyegaze_tpu_torch: the PyTorch and CUDA port of eyegaze_tpu for NVIDIA Hopper.

A second package beside the JAX one, which stays the reference.  The first
slice is the flagship EEG serving path: preprocessing (``ops.preprocess``),
the six-band spectral and connectivity math (``ops.spectral``,
``ops.connectivity``), the DualEEGTransformer (``models``) and the bucketed
``serving.Predictor``.  The flagship also trains here: ``config``, the
host-side data layer (``data``), losses, AdamW, metrics, checkpoints and
the trainer (``train``), behind ``train_dual_eeg`` and ``run_experiments``.
ART serves (``serving.ArtDenoiser``) and trains (``train_art``), its
attention in a hand CUDA kernel with an autograd backward
(``kernels.attention``); the gaze ViTs serve from uint8 image pairs
(``models.vit``, ``serving.GazePredictor``); ``serve`` is the HTTP front
end.  The connectivity block's phase metrics run in a hand CUDA kernel
(``kernels.phase_metrics``, sources in ``csrc/``), built with nvcc at first
use.  This package imports torch and never jax.
"""

__version__ = "0.1.0"
