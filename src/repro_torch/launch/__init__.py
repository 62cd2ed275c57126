"""Entry points: the batched serving driver (``launch.serve``) and the
pieces of the training driver it shares (``launch.train``)."""
