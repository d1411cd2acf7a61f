"""The plain reference that decides ``correct``: plain PyTorch on the CPU,
importing nothing of the program."""
