"""Training data of the PyTorch port (numpy; no JAX)."""

from geomconsistentfr_torch.data.celebahq import CelebAHQRelightingData, SyntheticFaceData, build_cache  # noqa: F401
