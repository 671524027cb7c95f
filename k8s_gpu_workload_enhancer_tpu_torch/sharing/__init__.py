"""Tenant drain for live sub-slice repartition."""
