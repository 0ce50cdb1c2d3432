"""The plain reference: NumPy and SciPy only, nothing of the program."""
