"""Host runtime of the PyTorch port: the native C++ library (decoders,
DTW, crossfades; ``native_lib``) and the batch driver's file prefetcher
(``prefetch``)."""
