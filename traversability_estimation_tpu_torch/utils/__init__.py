"""Configuration and state conversion."""
