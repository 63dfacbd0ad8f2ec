"""Test doubles of the PyTorch port (``webdav``: an in-process WebDAV
server over a local directory)."""
