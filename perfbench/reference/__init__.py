"""Plain PyTorch references, one module per model family, named by a
configuration file's ``model.reference``. They import nothing of the
program."""
