"""Test doubles of the PyTorch port (``webdav``: an in-process WebDAV
server over a local directory; ``chaos``: the seeded fault injector of
the serving fleet and the model lifecycle)."""
