"""Observability: named fit phases and serving metrics."""
