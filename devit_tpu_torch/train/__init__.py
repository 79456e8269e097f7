"""train of the PyTorch port (see the matching devit_tpu subpackage)."""
