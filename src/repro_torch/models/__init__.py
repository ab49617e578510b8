"""Models of the port: the dense GQA, SSM and hybrid transformer families'
serve path (``transformer.py``), their attention (``attention.py``,
prefill on the flash-attention kernel), the Mamba block (``ssm.py``,
prefill on the selective-scan kernel) and building blocks
(``layers.py``)."""
