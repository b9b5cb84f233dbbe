"""Serving tier: ingest gateway, query planner and the HTTP surface."""
