"""Serving structures of the port: KV carrier, paged pool, scheduler, tier."""
