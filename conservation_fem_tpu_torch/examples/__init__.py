"""The port's two entry scripts, the counterparts of the JAX package's
``examples/``: ``tutorial`` (the API end to end) and ``make_figures`` (the
figure gallery). Run each from the repository root with ``python -m
conservation_fem_tpu_torch.examples.<name>``. Each section of a script is
a function of its own that runs on the card unless given ``device="cpu"``;
drawing and XDMF need matplotlib, PIL and h5py, imported only where used."""
