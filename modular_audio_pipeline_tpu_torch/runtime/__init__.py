"""Host runtime of the PyTorch port: the native C++ library (decoders,
DTW, crossfades; ``native_lib``), the batch driver's file prefetcher
(``prefetch``) and the checksummed device transfers (``integrity``)."""
