"""The port's runtime: the distributed sweep template behind the Engine
API's ``"dist"`` backend (``dist_gibbs``)."""
