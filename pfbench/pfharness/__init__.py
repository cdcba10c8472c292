"""The port's benchmark harness: finds a cell's files by name, runs its
window, reads its metrics and holds its outputs against the plain reference
(``pfbench/reference``)."""
