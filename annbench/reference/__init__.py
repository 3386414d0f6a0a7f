"""The plain reference: PyTorch and NumPy only, nothing of the port.

Exact ground truth and float64 distances (``knn``), tie-aware recall
(``recall``), the scalar tier recomputed from its published formula
(``quant``), the adjacency's invariants (``graph``), and the control: the
reference's own search put in the program's place (``control``).
"""
