"""Paged serving: page/slot bookkeeping and the serving engine."""
