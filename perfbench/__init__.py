"""The benchmark of ``embeddings_tpu_torch`` (see README.md)."""
