"""The port's fixed-output stage; the other stages are the reference's."""
