"""Port package: interop."""
