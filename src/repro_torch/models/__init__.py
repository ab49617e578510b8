"""Models of the port: the dense GQA transformer family's serve path
(``transformer.py``), its attention (``attention.py``, prefill on the
flash-attention kernel) and building blocks (``layers.py``)."""
