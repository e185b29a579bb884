"""Plain references: one module per kind of configuration. A reference uses
NumPy and PyTorch alone and imports nothing of the program."""
