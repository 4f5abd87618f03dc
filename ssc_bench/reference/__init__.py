"""The plain reference the benchmark holds the program against: plain
torch, float32, importing nothing of the program."""
