"""Training of the PyTorch port: fine-tune the Whisper stack on (audio,
transcript) pairs, and train the VAD, diarization and separation models on
synthetic data.

Counterpart of ``modular_audio_pipeline_tpu/training``. The train steps run
on one card (a CPU when the caller asks for it); the encoder's flash kernel
is differentiated through its recompute backward (``ops/attention.py``).
Checkpoints save as the JAX layout's ``params.npz``, which both packages
load. Multi-card data and tensor parallelism are not ported yet.
"""

from .whisper_train import TrainState, cross_entropy_loss, make_train_step

__all__ = ["TrainState", "make_train_step", "cross_entropy_loss"]
