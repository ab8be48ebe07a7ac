"""Front artifacts on disk: one .npy per leaf plus metadata.json."""
