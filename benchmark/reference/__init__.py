"""Plain references of what the cells' timed paths produce.

Plain PyTorch and numpy only: nothing here imports the program under test,
JAX, or anything either of them made.
"""
