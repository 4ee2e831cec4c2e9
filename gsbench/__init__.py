"""The port's benchmark (python3 -m gsbench.run): see gsbench/run.py."""
