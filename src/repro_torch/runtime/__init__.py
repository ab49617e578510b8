"""The port's runtime: the distributed sweep template behind the Engine
API's ``"dist"`` backend (``dist_gibbs``), and the supervised sampling
runtime (``supervisor``) with its restart policy (``fault``) and
deterministic fault injection (``faultinject``)."""
