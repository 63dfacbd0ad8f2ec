"""Test doubles and harnesses of the PyTorch port (``webdav``: an
in-process WebDAV server over a local directory; ``chaos``: the seeded
fault injector of the serving fleet and the model lifecycle;
``fuzzing`` / ``fuzz_objects``: the structural fuzzing harness and a
TestObject for every registered stage; ``equality``, ``datagen``,
``benchmarks``, ``torch_models``: the JAX package's helpers of the same
names)."""
