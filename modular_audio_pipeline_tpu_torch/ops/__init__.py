"""Tensor ops of the PyTorch port: the Whisper front end (``framing``,
``mel``) and the hand-written CUDA kernels with their plain PyTorch
versions (``attention``, ``ancestor_attention``, ``quant``, and
``mla_decode`` for DeepSeek-V2's decode step; built by ``_build``)."""
