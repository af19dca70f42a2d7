"""Port package: runtime."""
