"""The GAN image replay pool (counterpart of gandtr_tpu/learning/
image_pool.py; the reference's tools/gan_image_pool.py:15-65): a history
of generated images that the discriminator sees in place of some of the
newest ones.

Per image, in batch order: while the pool is not full, the image is
stored and returned; once full, with probability 1/2 it replaces a
random stored image and that one is returned, else the image itself is
returned. `pool_size <= 0` returns the batch unchanged.

The buffer lives on the images' device; the draws come from the pool's
own CPU `torch.Generator` (two a image, full or not), so the choices are
known on the host and the query never waits for the card. The JAX pool
draws from jax.random: the two agree exactly while the pool is not full
(the input comes back whatever the draws) and follow the same law after.
`state_dict` holds the buffer, the count and the generator's state, so a
resumed epoch draws what the straight run drew.
"""
import torch


class ImagePool:
    def __init__(self, pool_size, seed=0):
        self.pool_size = int(pool_size)
        self.generator = torch.Generator().manual_seed(int(seed))
        self.images = None      # (pool_size, H, W, C), made at first use
        self.count = 0

    def query(self, images):
        """images (B, H, W, C), without autograd -> the batch for D."""
        if self.pool_size <= 0:
            return images
        if self.images is None:
            self.images = images.new_zeros((self.pool_size,)
                                           + tuple(images.shape[1:]))
        out = []
        for img in images:
            p = float(torch.rand((), generator=self.generator))
            rid = int(torch.randint(self.pool_size, (),
                                    generator=self.generator))
            if self.count < self.pool_size:
                self.images[self.count] = img
                self.count += 1
                out.append(img)
            elif p > 0.5:
                out.append(self.images[rid].clone())
                self.images[rid] = img
            else:
                out.append(img)
        return torch.stack(out)

    def state_dict(self):
        return {"images": None if self.images is None
                else self.images.detach().cpu(),
                "count": self.count,
                "generator": self.generator.get_state()}

    def load_state_dict(self, state, device=None):
        images = state["images"]
        self.images = None if images is None else images.to(device)
        self.count = int(state["count"])
        self.generator.set_state(state["generator"])
