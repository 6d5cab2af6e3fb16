"""int8 x int8 -> int32 matmul kernel (`kernel.py`, `csrc/qmatmul.cu`)."""
