"""Grid geometry and the layered map container."""
