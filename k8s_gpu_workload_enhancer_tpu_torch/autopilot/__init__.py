"""The traffic trace the autopilot replays (trace.py): capture and file I/O."""
