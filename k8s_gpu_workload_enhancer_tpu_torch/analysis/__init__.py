"""Runtime checks of the PyTorch port (compilewatch.py: the program-event sentinel)."""
