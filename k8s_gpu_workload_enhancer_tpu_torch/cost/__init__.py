"""The serve's tenant metering and budget admission (cost_engine.py)."""
