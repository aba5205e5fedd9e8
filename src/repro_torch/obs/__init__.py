"""Observability: named fit phases."""
