"""Traffic: the clip generator (scene.py) and one data file a mix."""
