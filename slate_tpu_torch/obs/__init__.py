"""Port package: obs."""
