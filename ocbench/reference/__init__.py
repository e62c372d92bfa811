"""The plain reference the benchmark judges the program by: plain PyTorch,
fp32, importing nothing of the program."""
