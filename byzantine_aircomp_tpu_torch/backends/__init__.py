"""The NumPy referee: :mod:`.numpy_ref` (the server-side math) and
:mod:`.ref_trainer` (``--backend ref``, the training loop), NumPy only."""
