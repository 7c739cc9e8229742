"""Vocal/accompaniment separation models of the PyTorch port: REPET, the
weight-free repeating-pattern separator (:mod:`.repet`), and the trained
spectrogram-masking U-Net (:mod:`.unet`)."""
