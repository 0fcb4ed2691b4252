"""The benchmark's plain reference: scenes, camera, renderer and work
counter, in plain PyTorch; it imports nothing of the program."""
