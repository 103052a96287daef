"""Model code of the PyTorch port: parameter trees (``params``) and the
BERT encoder forward (``bert``)."""
