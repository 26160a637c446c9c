"""Serving: artifact repository, dynamic batcher and HTTP front end."""
