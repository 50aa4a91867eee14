from .net import Net, Params
