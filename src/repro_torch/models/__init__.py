"""Model zoo: the dense and VLM decoder-only transformers, initialized
from ThundeRiNG streams and served through ``registry.build``."""
