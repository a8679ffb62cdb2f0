"""The benchmark's plain reference of stereo visual odometry: plain PyTorch
and NumPy, independent of the program under test (it imports none of it).
``odometry`` holds the camera, the per-frame extraction and the odometer's
state machine; the other modules are the stages it calls."""
