"""Batched RANSAC estimators: five-point essential + recoverPose, DLT PnP."""
