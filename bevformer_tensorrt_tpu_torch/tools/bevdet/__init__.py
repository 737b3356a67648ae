"""The BEVDet CLIs of the port: train, evaluate and calibrate."""
