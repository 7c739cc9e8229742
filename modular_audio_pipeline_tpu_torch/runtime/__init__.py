"""Host runtime of the PyTorch port: the native C++ library (decoders,
DTW, crossfades; ``native_lib``), the batch driver's file prefetcher
(``prefetch``), the checksummed device transfers (``integrity``) and the
spans and counters recorded on request (``tracing``)."""
