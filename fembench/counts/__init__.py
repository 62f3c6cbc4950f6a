"""Frozen work counts and the card's peaks: the yardstick of the roofline
metrics, copied from the program's ``utils/roofline.py`` so that a change
to the program cannot move it."""
