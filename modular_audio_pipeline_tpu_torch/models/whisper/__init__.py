"""Whisper in PyTorch: encoder/decoder, KV-cached beam and greedy
decoding, tokenizer and checkpoint loading."""
