"""Tensor numerics: embeddings, boxes, sted decode, on-device preprocess."""
