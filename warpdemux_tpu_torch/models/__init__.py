"""Model registry and the DTW-SVM classifier."""
