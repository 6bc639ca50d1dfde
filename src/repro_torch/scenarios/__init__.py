"""The part of the attack zoo the static sync round runs."""
