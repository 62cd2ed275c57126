"""Arithmetic cores, sampler stages, the engine and the stream API."""
