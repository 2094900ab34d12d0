"""Plain torch and numpy pieces shared by the configurations' references."""
