"""Plain PyTorch references the benchmark judges the program's outputs by.
They import nothing of the program and take nothing it made."""
