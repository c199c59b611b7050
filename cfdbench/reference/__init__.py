"""The plain reference the benchmark judges the program's outputs by.

Imports nothing of the program: only NumPy and PyTorch.
"""
