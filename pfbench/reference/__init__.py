"""The plain reference that decides ``correct``: PyTorch and NumPy only.

It imports nothing of the program under test. It gets the inputs the
program got (the target, its data, the initial points) and the program's
outputs, works out again what the program derived (the log density and its
gradient at every iterate, each L-BFGS direction, the fit at each path's
winner, the ELBO of the winner's draws, the importance ratios, PSIS), and
returns the gap between each output and its reference value
(:func:`reference.check.readings`).
"""
