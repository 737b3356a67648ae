"""The BEVDet CLIs of the port: evaluate and calibrate."""
