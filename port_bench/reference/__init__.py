"""The benchmark's reference: its own plain PyTorch charge chain
(``charge.py``) on its own reading of the configuration (``detector.py``),
and the frozen copies of what it shares with the program: the HDF5 reader
and the stand-in asset writers (``frozen/``)."""
