"""tools of the PyTorch port (mirrors the repository's tools/)."""
