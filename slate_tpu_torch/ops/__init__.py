"""Port package: ops."""
