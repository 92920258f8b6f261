"""The plain reference: the ptychography model, its loss, Adam and the
constraints in plain PyTorch and NumPy. It imports nothing of the program
under test and works out every derived table again from the inputs."""
