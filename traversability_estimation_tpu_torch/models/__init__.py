"""The estimator API."""
