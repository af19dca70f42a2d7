"""Port package: linalg."""
