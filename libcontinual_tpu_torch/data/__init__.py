"""Data: sources, continual task streams and device-side transforms."""
