"""One module per assigned architecture (+ the paper's own LeNet workload).

Each module builds a full-size ``ModelConfig`` with the exact published dims and
a reduced smoke config of the same family, then registers both.
"""
