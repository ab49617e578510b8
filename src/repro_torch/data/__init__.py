"""Data: the deterministic synthetic token pipeline (a copy of the JAX
package's)."""
from .pipeline import SyntheticTokens, make_batch

__all__ = ["SyntheticTokens", "make_batch"]
