"""The benchmark's plain reference: frozen copies that import nothing of the program.

``courtyard.py`` is the frozen scene generator; ``plain/`` is a frozen copy of
the program's frame path in plain PyTorch, with the hand kernels' plain walks
in their place (each file's header names the file and commit it was copied
from, and what changed).
"""
