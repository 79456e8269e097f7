"""The devit-torch command line (see __main__.py)."""
