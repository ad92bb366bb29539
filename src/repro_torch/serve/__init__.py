"""Serving substrate of the port: the request journal, the paged-KV LRU
allocator and the serving engine."""
