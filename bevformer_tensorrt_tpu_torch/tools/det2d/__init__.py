"""The 2D family's CLIs of the port (YOLOX, CenterNet): evaluate and calibrate."""
