"""Default parameters exported to the Python API.

Reference: python/module.cpp:142-148 and python/defaults.py; the same
constants as parlayann_tpu/defaults.py.
"""

ALPHA = 1.2
GRAPH_DEGREE = 64
COMPLEXITY = 128  # build beam width (L)
BEAMWIDTH = 128  # query beam width (Q)
HNSW_M = 20
HNSW_EFC = 50
HNSW_ALPHA = 0.9
HNSW_ML = 0.34
HCNNG_NUM_CLUSTERS = 30
HCNNG_CLUSTER_SIZE = 1000
HCNNG_MST_DEG = 3
PYNN_K = 40
PYNN_CLUSTER_SIZE = 100
PYNN_NUM_CLUSTERS = 10
PYNN_DELTA = 0.05
RERANK_FACTOR = 10
