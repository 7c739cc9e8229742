"""Speaker diarization models of the PyTorch port: MFCC features, the
powerset segmentation network, the conv speaker embedder and host AHC."""
