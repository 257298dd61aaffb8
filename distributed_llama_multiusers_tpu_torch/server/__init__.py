from .http import ApiServer
