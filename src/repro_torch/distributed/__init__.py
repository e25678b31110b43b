"""Fetch-path substrate of the port: the bounded device row cache."""
