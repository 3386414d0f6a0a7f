"""Standalone dataset tools (reference: data_tools/*.cpp), counterparts of
parlayann_tpu/tools.

Each is runnable as ``python -m parlayann_tpu_torch.tools.<name>``:
  compute_groundtruth        exact k-NN ibin (compute_groundtruth.cpp)
  compute_range_groundtruth  radius ground truth (compute_range_groundtruth.cpp)
  vec_to_bin                 .fvecs/.bvecs/.ivecs -> .bin (vec_to_bin.cpp)
  crop                       first-n slice of a bin file (crop.cpp)
  random_sample              random subset of a bin file (random_sample.cpp)

The two ground-truth tools run on the card unless ``-device`` names
another device (``-device cpu``).
"""
